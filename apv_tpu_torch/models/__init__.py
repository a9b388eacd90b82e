"""Networks of the PyTorch port: the ResNet VAE and the latent D."""

from apv_tpu_torch.models.discriminator import (LatentDiscriminator,
                                                make_latent_d)
from apv_tpu_torch.models.registry import build_model
from apv_tpu_torch.models.resnet_vae import ResNetVAE

__all__ = ["LatentDiscriminator", "ResNetVAE", "build_model",
           "make_latent_d"]
