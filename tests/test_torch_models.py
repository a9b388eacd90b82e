"""The port's ResNet VAE and latent D against the flax modules of
``apv_tpu``, with flax weights carried across by ``apv_tpu_torch.convert``.

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
from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.models import LatentDiscriminator, ResNetVAE
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
