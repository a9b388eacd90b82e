"""The port's discriminators and their loss terms against ``apv_tpu``'s:
the numpy Threefry draw of the spectral norm's start vector, ``SNDense``
and the spectrally normalized latent D, ``PixelDiscriminator`` (f32 and
bf16), ``r1_penalty`` with its parameter gradient, ``pixel_g_term`` and
``likelihood_pixel_mean``.

Both sides run on the same numpy inputs and converted flax weights.
Tolerances: values element-wise (f32 matmuls and convs in another
summation order: 1e-5), gradients scale-relative max|Δ|/max|grad| ≤ 1e-3,
the bf16 pixel D at 3·2⁻⁸ of its output's scale (three bf16 conv layers,
the ``tests/test_torch_bf16.py`` bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.models.discriminator import PixelDiscriminator as FlaxPixelD
from apv_tpu.models.discriminator import SNDense as FlaxSNDense
from apv_tpu.models.discriminator import latent_d_params as j_latent
from apv_tpu.training import losses as jlosses
from apv_tpu_torch.convert import d_params_from_flax
from apv_tpu_torch.models import (LatentDiscriminator, PixelDiscriminator,
                                  SNDense, latent_d_params, make_latent_d)
from apv_tpu_torch.training import losses as tlosses
from apv_tpu_torch.utils import jax_prng
from apv_tpu_torch.utils.config import AdversarialConfig

torch.set_num_threads(1)

U = 2.0 ** -8            # bf16's unit roundoff


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the start vector ---------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(0, 8), (8 * 31 + 32, 8),
                                    (40 * 31 + 256, 40),
                                    (128 * 31 + 256, 128),
                                    (256 * 31 + 1, 256), (2 ** 31 + 7, 33),
                                    (12345, 1000)])
def test_threefry_normal_matches_jax(seed, n):
    """The bits are JAX's exactly; the normals agree to 2e-6 (scipy's
    float64 erfinv rounded to f32 against XLA's f32 erfinv, |x| < 3.5)."""
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        jax_prng.random_bits(seed, n),
        np.asarray(jax.random.bits(key, (n,), jnp.uint32)))
    np.testing.assert_allclose(jax_prng.normal(seed, n),
                               np.asarray(jax.random.normal(key, (n,))),
                               rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="outside"):
        jax_prng.normal(2 ** 32, 2)


# -- SNDense and the spectrally normalized latent D --------------------------

def _sn_pair(kernel, bias):
    d_in, feats = kernel.shape
    layer = SNDense(d_in, feats)
    with torch.no_grad():
        layer.weight.copy_(_t(kernel.T))
        layer.bias.copy_(_t(bias))
    params = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    return layer, params, FlaxSNDense(feats)


@pytest.mark.parametrize("d_in,feats", [(8, 32), (32, 32), (32, 1),
                                        (128, 256)])
def test_sn_dense_matches_flax(d_in, feats):
    """Values, and the gradients of Σ·y² with respect to the kernel, the
    bias and x (u, v detached on both sides)."""
    rng = np.random.default_rng(d_in + feats)
    kernel = rng.normal(size=(d_in, feats)).astype(np.float32)
    bias = rng.normal(size=(feats,)).astype(np.float32)
    x = rng.normal(size=(6, d_in)).astype(np.float32)
    layer, params, flax_layer = _sn_pair(kernel, bias)

    def j_loss(p, xx):
        return jnp.sum(flax_layer.apply({"params": p}, xx) ** 2)

    want = flax_layer.apply({"params": params}, x)
    gp, gx = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = layer(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    gw, gb, gxt = torch.autograd.grad((y ** 2).sum(),
                                      (layer.weight, layer.bias, xt))
    assert _rel(gw.numpy().T, gp["kernel"]) <= 1e-3
    assert _rel(gb.numpy(), gp["bias"]) <= 1e-3
    assert _rel(gxt.numpy(), gx) <= 1e-3
    assert "v0" not in layer.state_dict()


def test_sn_dense_zero_column_sum_kernel():
    """Columns summing to zero are orthogonal to an all-ones start; the
    random fixed start finds the true σ (the reference's regression)."""
    kernel = np.array([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [0.0] * 3,
                       [0.0] * 3], np.float32)
    layer, params, flax_layer = _sn_pair(kernel, np.zeros(3, np.float32))
    x = np.eye(4, dtype=np.float32)
    with torch.no_grad():
        y = layer(_t(x)).numpy()
    assert np.all(np.isfinite(y))
    sigma = np.linalg.svd(kernel, compute_uv=False)[0]
    np.testing.assert_allclose(y, x @ (kernel / sigma), atol=1e-5)
    np.testing.assert_allclose(
        y, np.asarray(flax_layer.apply({"params": params}, x)), atol=1e-6)


def test_sn_dense_zero_kernel_degrades_to_zero_map():
    layer, _, _ = _sn_pair(np.zeros((4, 3), np.float32),
                           np.zeros(3, np.float32))
    y = layer(torch.ones(2, 4))
    assert torch.equal(y.detach(), torch.zeros(2, 3))
    (g,) = torch.autograd.grad(y.sum(), layer.weight)
    assert bool(torch.isfinite(g).all())


def test_sn_latent_d_matches_flax():
    """make_latent_d builds the SN latent D (the refusal is gone); the
    converted flax SN tree gives the same logits and parameter gradients."""
    adv = AdversarialConfig(enabled=True, d_widths=(32, 32),
                            d_spectral_norm=True)
    td = make_latent_d(adv, 8, device="cpu")
    assert all(isinstance(layer, SNDense) for layer in td.layers)
    fd = FlaxD((32, 32), spectral_norm=True)
    z = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    params = jax.tree.map(lambda a: 3.0 * a + 0.05,
                          fd.init(jax.random.PRNGKey(1), z)["params"])
    assert set(params) == {"SNDense_0", "SNDense_1", "SNDense_2"}
    td.load_state_dict(d_params_from_flax(_np_tree(params)), strict=True)
    out = td(_t(z))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(fd.apply({"params": params}, z)),
                               rtol=1e-5, atol=1e-5)
    gj = d_params_from_flax(_np_tree(jax.grad(lambda p: jnp.sum(jnp.tanh(
        fd.apply({"params": p}, z))))(params)))
    gt = torch.autograd.grad(torch.tanh(out).sum(), list(td.parameters()))
    for (name, _), g in zip(td.named_parameters(), gt):
        assert _rel(g.numpy(), gj[name].numpy()) <= 1e-3, name


# -- the pixel D --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(28, 28, 1), (32, 32, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_discriminator_matches_flax(shape, dtype):
    """Flax's 'SAME' pads (the 7 -> 4 stage pads (1, 2)) and NHWC flatten:
    f32 logits at 1e-5, bf16 at 3·2⁻⁸ of their scale; the converted Dense
    needs no permute."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(3)
    x = rng.random((5, *shape)).astype(np.float32)
    fpx = FlaxPixelD(dtype=jdt)
    params = fpx.init(jax.random.PRNGKey(2), x)["params"]
    params = jax.tree.map(lambda a: 3.0 * a + 0.02, params)
    tpx = PixelDiscriminator(shape, dtype=tdt)
    assert tpx.head.weight.shape == (1, 4 * 4 * 128)
    sd = d_params_from_flax({"latent": {}, "pixel": _np_tree(params)})
    tpx.load_state_dict({k.removeprefix("pixel."): v for k, v in sd.items()
                         if k.startswith("pixel.")}, strict=True)
    want = np.asarray(fpx.apply({"params": params}, x), np.float32)
    with torch.no_grad():
        got = tpx(_t(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (5,)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got, want) <= 3 * U


def test_latent_d_params_routes_the_pair():
    lat = LatentDiscriminator(8, (16,))
    pair = torch.nn.ModuleDict({"latent": lat,
                                "pixel": PixelDiscriminator((28, 28, 1))})
    assert latent_d_params("biadversarial", pair) is lat
    assert latent_d_params("learned_prior", lat) is lat
    assert latent_d_params("biadversarial", None) is None
    assert j_latent("biadversarial", {"latent": 1, "pixel": 2}) == 1


# -- the loss terms -----------------------------------------------------------

@pytest.mark.parametrize("which", ["latent", "pixel"])
def test_r1_penalty_and_its_parameter_gradient_match_jax(which):
    """½·E‖∇ₓD‖² on real samples and its gradient with respect to D's
    parameters (the second backward), against jax.grad of the
    reference's; the pixel D on binary images, where LeakyReLU's
    derivative at 0 matters."""
    rng = np.random.default_rng(5)
    if which == "latent":
        fd = FlaxD((32, 32), spectral_norm=True)
        x = rng.normal(size=(12, 8)).astype(np.float32)
        td = LatentDiscriminator(8, (32, 32), spectral_norm=True)
    else:
        fd = FlaxPixelD((8, 16, 16), dtype=jnp.float32)
        x = (rng.random((6, 28, 28, 1)) < 0.3).astype(np.float32)
        td = PixelDiscriminator((28, 28, 1), (8, 16, 16),
                                dtype=torch.float32)
    params = jax.tree.map(lambda a: 2.0 * a + 0.01,
                          fd.init(jax.random.PRNGKey(3), x)["params"])
    sd = d_params_from_flax(_np_tree(params) if which == "latent" else
                            {"latent": {}, "pixel": _np_tree(params)})
    td.load_state_dict({k.removeprefix("pixel."): v for k, v in sd.items()},
                       strict=True)

    def j_r1(p):
        return jlosses.r1_penalty(lambda xx: fd.apply({"params": p}, xx),
                                  jnp.asarray(x))

    want, gj = jax.value_and_grad(j_r1)(params)
    got = tlosses.r1_penalty(td, _t(x))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    # ∇ₓD does not depend on the head's bias: no gradient reaches it
    gt = [torch.zeros_like(p) if g is None else g for p, g in zip(
        td.parameters(), torch.autograd.grad(got, list(td.parameters()),
                                             allow_unused=True))]
    gj = d_params_from_flax(_np_tree(gj) if which == "latent" else
                            {"latent": {}, "pixel": _np_tree(gj)})
    gj = {k.removeprefix("pixel."): v for k, v in gj.items()}
    for (name, _), g in zip(td.named_parameters(), gt):
        assert _rel(g.numpy(), gj[name].numpy()) <= 1e-3, name


def test_pixel_g_term_and_pixel_mean_match_jax():
    rng = np.random.default_rng(7)
    logits = (6.0 * rng.normal(size=(64,))).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.pixel_g_term(_t(logits)).numpy(),
        np.asarray(jlosses.pixel_g_term(logits)), rtol=1e-6, atol=1e-6)
    for lik, c_out in (("bernoulli", 1), ("discretized_logistic", 6)):
        out = (2.0 * rng.normal(size=(3, 8, 8, c_out))).astype(np.float32)
        c = 1 if lik == "bernoulli" else 3
        got = tlosses.likelihood_pixel_mean(_t(out), lik, c)
        want = jlosses.likelihood_pixel_mean(jnp.asarray(out), lik, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
