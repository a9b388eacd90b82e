"""Networks of the PyTorch port: the conv and ResNet VAEs and the latent
D."""

from apv_tpu_torch.models.conv_vae import ConvVAE
from apv_tpu_torch.models.discriminator import (LatentDiscriminator,
                                                make_latent_d)
from apv_tpu_torch.models.registry import build_model
from apv_tpu_torch.models.resnet_vae import ResNetVAE

__all__ = ["ConvVAE", "LatentDiscriminator", "ResNetVAE", "build_model",
           "make_latent_d"]
