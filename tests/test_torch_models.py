"""The port's ResNet and conv VAEs and latent D against the flax modules
of ``apv_tpu``, with flax weights carried across by ``apv_tpu_torch.convert``.

Both sides compute in float32 here (flax ``dtype=jnp.float32``, torch
``dtype=torch.float32``): the point is the architecture — padding, flatten
orders, norms, activations and the converter's layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.models.common import get_activation as flax_act
from apv_tpu.models.conv_vae import ConvVAE as FlaxConvVAE
from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.models import ConvVAE, LatentDiscriminator, ResNetVAE
from apv_tpu_torch.models.common import get_activation

torch.set_num_threads(1)

# (norm, upsample, activation, widths, blocks_per_stage)
CASES = [(n, u, a, (8, 16), 1)
         for n in ("rms", "group", "none")
         for u in ("conv_transpose", "nearest")
         for a in ("silu", "gelu")]
# the flagship's structure in miniature: three stages, two blocks each
CASES.append(("rms", "conv_transpose", "silu", (8, 16, 16), 2))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("norm,upsample,activation,widths,blocks", CASES)
def test_resnet_vae_matches_flax(norm, upsample, activation, widths, blocks):
    rng = np.random.default_rng(11)
    kw = dict(z_dim=8, widths=widths, blocks_per_stage=blocks,
              image_shape=(32, 32, 3), upsample=upsample,
              activation=activation, norm=norm)
    x = rng.uniform(-1, 1, size=(4, 32, 32, 3)).astype(np.float32)
    z = rng.normal(size=(4, 8)).astype(np.float32)
    fmodel = FlaxVAE(dtype=jnp.float32, **kw)
    params = fmodel.init(jax.random.PRNGKey(0), x, z)["params"]
    # non-trivial norm params so a swapped scale/bias would show
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), p.shape)
        if str(path[-1]) in ("['scale']", "['bias']") else p, params)

    tmodel = ResNetVAE(dtype=torch.float32, **kw)
    tmodel.load_state_dict(params_from_flax(_np_tree(params)), strict=True)

    want_m, want_lv = fmodel.apply({"params": params}, x, method="encode")
    want_out = fmodel.apply({"params": params}, z, method="decode")
    with torch.no_grad():
        got_m, got_lv = tmodel.encode(torch.from_numpy(x))
        got_out = tmodel.decode(torch.from_numpy(z))
    assert got_out.shape == (4, 32, 32, 6)
    # float32 convs summed in another order through <= 13 layers of O(1)
    # activations: 1e-4 relative / 1e-4 absolute.
    for got, want in ((got_m, want_m), (got_lv, want_lv),
                      (got_out, want_out)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


# (activation, logvar head bias): a bias of ±40 drives the raw logvar far
# past the 8·tanh(lv/8) soft bound, so a missing or wrong cap shows.
CONV_CASES = [("gelu", 0.0), ("silu", 0.0), ("gelu", 40.0)]


@pytest.mark.parametrize("activation,head_bias", CONV_CASES)
def test_conv_vae_matches_flax(activation, head_bias):
    """MNIST conv VAE: stride-2 SAME pads on 28 -> 14 -> 7, the (h, w, c)
    flatten before the encoder's Dense and reshape after the decoder's,
    the reversed decoder widths, nearest upsampling, the f32 heads and the
    logvar cap, all through the converter."""
    rng = np.random.default_rng(13)
    kw = dict(z_dim=8, widths=(8, 16), dense=32, image_shape=(28, 28, 1),
              activation=activation)
    x = (rng.random((4, 28, 28, 1)) < 0.3).astype(np.float32)
    z = rng.normal(size=(4, 8)).astype(np.float32)
    fmodel = FlaxConvVAE(dtype=jnp.float32, **kw)
    params = fmodel.init(jax.random.PRNGKey(2), x, z)["params"]
    if head_bias:
        bias = np.asarray(params["encoder"]["gaussian_head"]["bias"]).copy()
        bias[8:] = head_bias * np.sign(rng.normal(size=8))
        params = jax.tree.map(lambda a: a, params)
        params["encoder"]["gaussian_head"]["bias"] = jnp.asarray(bias)
    tmodel = ConvVAE(dtype=torch.float32, **kw)
    tmodel.load_state_dict(params_from_flax(_np_tree(params)), strict=True)

    want_m, want_lv = fmodel.apply({"params": params}, x, method="encode")
    want_out = fmodel.apply({"params": params}, z, method="decode")
    with torch.no_grad():
        got_m, got_lv = tmodel.encode(torch.from_numpy(x))
        got_out = tmodel.decode(torch.from_numpy(z))
    assert got_out.shape == (4, 28, 28, 1)
    if head_bias:
        assert float(got_lv.abs().max()) > 7.0     # the cap is reached
    # float32 convs and two Dense layers summed in another order through
    # 8 layers of O(1) activations: the ResNet's bar, 1e-4 rel / 1e-4 abs.
    for got, want in ((got_m, want_m), (got_lv, want_lv),
                      (got_out, want_out)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_converter_covers_both_families():
    """``params_from_flax`` tells the two families apart and leaves no
    parameter of either unset or extra (strict loads)."""
    z = np.zeros((1, 8), np.float32)
    conv = FlaxConvVAE(z_dim=8, widths=(8, 16), dense=32, dtype=jnp.float32)
    p_conv = conv.init(jax.random.PRNGKey(0), np.zeros((1, 28, 28, 1),
                                                       np.float32), z)
    res = FlaxVAE(z_dim=8, widths=(8, 16), blocks_per_stage=1,
                  dtype=jnp.float32)
    p_res = res.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3),
                                                     np.float32), z)
    sd_conv = params_from_flax(_np_tree(p_conv["params"]))
    sd_res = params_from_flax(_np_tree(p_res["params"]))
    assert "decoder.dense1.weight" in sd_conv and not any(
        "blocks" in k for k in sd_conv)
    assert any("blocks" in k for k in sd_res)
    ConvVAE(z_dim=8, widths=(8, 16), dense=32,
            dtype=torch.float32).load_state_dict(sd_conv, strict=True)
    ResNetVAE(z_dim=8, widths=(8, 16), blocks_per_stage=1,
              dtype=torch.float32).load_state_dict(sd_res, strict=True)
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(p_conv))
    assert n_flax == sum(v.numel() for v in sd_conv.values())


def test_latent_discriminator_matches_flax():
    rng = np.random.default_rng(12)
    z = (2.0 * rng.normal(size=(16, 8))).astype(np.float32)
    fd = FlaxD((32, 32))
    params = fd.init(jax.random.PRNGKey(1), z)["params"]
    td = LatentDiscriminator(8, (32, 32))
    td.load_state_dict(d_params_from_flax(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = td(torch.from_numpy(z)).numpy()
    # two f32 matmuls of width 32
    np.testing.assert_allclose(got, np.asarray(fd.apply({"params": params}, z)),
                               rtol=1e-5, atol=1e-5)


def test_spectral_norm_d_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="SNDense"):
        LatentDiscriminator(8, (32, 32), spectral_norm=True)


@pytest.mark.parametrize("name", ["gelu", "gelu_sigmoid", "silu", "relu",
                                  "leaky_relu"])
def test_activation_registry_matches_flax(name):
    x = np.linspace(-6, 6, 257, dtype=np.float32)
    # one f32 elementwise function: a few ulps
    np.testing.assert_allclose(get_activation(name)(torch.from_numpy(x)),
                               np.asarray(flax_act(name)(x)), rtol=1e-6,
                               atol=1e-6)
