"""Networks of the PyTorch port: the conv and ResNet VAEs and the
discriminators."""

from apv_tpu_torch.models.conv_vae import ConvVAE
from apv_tpu_torch.models.discriminator import (LatentDiscriminator,
                                                PixelDiscriminator, SNDense,
                                                latent_d_params,
                                                make_discriminators,
                                                make_latent_d)
from apv_tpu_torch.models.registry import build_model
from apv_tpu_torch.models.resnet_vae import ResNetVAE

__all__ = ["ConvVAE", "LatentDiscriminator", "PixelDiscriminator",
           "ResNetVAE", "SNDense", "build_model", "latent_d_params",
           "make_discriminators", "make_latent_d"]
